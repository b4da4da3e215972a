"""Fixture: the port importing JAX or the JAX package (jax-import-in-port)."""
import jax
import jax.numpy as jnp
from jaxlib import xla_client
from repro.core import site
import numpy as np
from repro_torch import rng


def use(x):
    return jax, jnp.asarray(x), xla_client, site, np, rng
