"""Stub of the port's native C++ library: never available, so every
caller takes its plain Python/NumPy path."""

BUILD_ERROR = None


def available() -> bool:
    return False
