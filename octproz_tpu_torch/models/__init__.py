"""Stateful model wrappers around the functional pipeline."""

from .fdoct import FdOctModel  # noqa: F401
