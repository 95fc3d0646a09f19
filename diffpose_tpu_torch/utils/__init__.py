"""Utilities: the TSV training-curve logger, the program's spans and the
profiler trace (``profiling``); ``memory`` (batch sizing from the device's
memory) and ``visualization`` (pose animations) are imported by name.  The
JAX package's ``utils/aot_cache.py`` serves only the TPU's remote compiler:
its counterpart here is the CUDA kernels' build cache under ``build/``
(``ops/_build.py``)."""

from diffpose_tpu_torch.utils.profiling import SPANS, span, trace_profile
from diffpose_tpu_torch.utils.tsv_logger import Logger, LoggerMonitor, savefig

__all__ = ["Logger", "LoggerMonitor", "savefig", "SPANS", "span", "trace_profile"]
