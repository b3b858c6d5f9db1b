from .engine import ContinuousBatcher, Request

__all__ = ["ContinuousBatcher", "Request"]
