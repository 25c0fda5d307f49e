from .registration import (ApiDefinition, load_definitions,
                           register_definitions, routes_from_definitions)
from .router import Gateway, Route

__all__ = ["ApiDefinition", "Gateway", "Route", "load_definitions",
           "register_definitions", "routes_from_definitions"]
