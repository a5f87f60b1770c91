"""Utilities of the port."""

from .logging import (MetricsLogger, append_event, is_primary,
                      print_primary)

__all__ = ["MetricsLogger", "append_event", "is_primary", "print_primary"]
