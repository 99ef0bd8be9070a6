"""CPU fallback operators."""
