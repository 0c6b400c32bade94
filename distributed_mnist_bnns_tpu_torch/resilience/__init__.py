from .policy import CircuitBreaker
from .preempt import StopRequest

__all__ = ["CircuitBreaker", "StopRequest"]
