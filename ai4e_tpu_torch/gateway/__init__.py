from .router import Gateway, Route

__all__ = ["Gateway", "Route"]
