"""Messaging contracts.

Counterpart of ``oryx_tpu/kafka/api.py`` (reference: KeyMessage.java:28,
TopicProducer.java:29, and the update-topic key protocol: "MODEL"
inline PMML, "MODEL-REF" a storage path or manifest envelope, "UP" an
app-defined JSON delta — MLUpdate.java:215-237).
"""

from __future__ import annotations

from typing import NamedTuple, Protocol, runtime_checkable

__all__ = ["KeyMessage", "TopicProducer", "KEY_MODEL", "KEY_MODEL_REF",
           "KEY_UP"]

# update-topic key protocol (wire contract)
KEY_MODEL = "MODEL"
KEY_MODEL_REF = "MODEL-REF"
KEY_UP = "UP"


class KeyMessage(NamedTuple):
    """A (key, message) pair from a topic, with optional record headers
    (best-effort metadata; consumers treat them as absent by default)."""

    key: str | None
    message: str
    headers: dict[str, str] | None = None


@runtime_checkable
class TopicProducer(Protocol):
    """Wraps access to a message topic to write to."""

    def send(self, key: str | None, message: str,
             headers: dict[str, str] | None = None) -> None: ...

    def get_update_broker(self) -> str: ...

    def get_topic(self) -> str: ...

    def close(self) -> None: ...
