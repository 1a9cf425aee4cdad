"""Plain versions of the port's device functions (CPU tensors only)."""
