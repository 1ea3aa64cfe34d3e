"""Optional packages, imported when a call needs them (never when a module
of the port is imported): the card machine may lack them."""

from __future__ import annotations


def cv2():
    """OpenCV's module, or None where it is not installed."""
    try:
        import cv2 as module
    except ImportError:
        return None
    return module
