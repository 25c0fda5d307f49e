from .dispatcher import (AWAITING_STATUS, BACKPRESSURE_CODES, Dispatcher,
                         DispatcherPool)
from .queue import EndpointQueue, InMemoryBroker, Message

__all__ = ["AWAITING_STATUS", "BACKPRESSURE_CODES", "Dispatcher",
           "DispatcherPool", "EndpointQueue", "InMemoryBroker", "Message"]
