"""Serving steps of the port: prefill and greedy single-token decode."""
from repro_torch.serve.serve_step import greedy_sample, make_decode_step, make_prefill

__all__ = ["greedy_sample", "make_decode_step", "make_prefill"]
