from .dispatcher import (AWAITING_STATUS, BACKPRESSURE_CODES, Dispatcher,
                         DispatcherPool)
from .push import PushEvent, PushTopic, SubscriptionError, WebhookDispatcher
from .queue import EndpointQueue, InMemoryBroker, Message

__all__ = ["AWAITING_STATUS", "BACKPRESSURE_CODES", "Dispatcher",
           "DispatcherPool", "EndpointQueue", "InMemoryBroker", "Message",
           "PushEvent", "PushTopic", "SubscriptionError",
           "WebhookDispatcher"]
