"""Serving in the port: the prefill and greedy decode steps (here), the
continuous-batching engine over a paged KV cache (``serve.engine.Engine``,
through ``Runtime.serve``), the run-to-completion baseline
(``serve.legacy.RunToCompletionEngine``), ``serve.config.ServeConfig``,
``serve.scheduler`` and ``serve.kv_cache``."""
from repro_torch.serve.serve_step import greedy_sample, make_decode_step, make_prefill

__all__ = ["greedy_sample", "make_decode_step", "make_prefill"]
