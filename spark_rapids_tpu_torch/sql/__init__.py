"""User-facing SQL/DataFrame surface: Session, DataFrame, Column, functions."""

from .session import Session  # noqa: F401
from .column import Column  # noqa: F401
from . import functions  # noqa: F401
