"""The engine's KV events: the publisher (``publisher.py``) on the port's
own ZMTP PUB socket (``zmtp.py``). The router's subscriber and block index
(``llmd_tpu/events/subscriber.py``, ``index.py``) are control-plane code
that reads them; they are not part of the port."""

from llmd_tpu_torch.events.publisher import ZMQEventSink  # noqa: F401
