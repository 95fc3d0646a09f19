"""Utilities: the TSV training-curve logger."""

from diffpose_tpu_torch.utils.tsv_logger import Logger, LoggerMonitor, savefig

__all__ = ["Logger", "LoggerMonitor", "savefig"]
