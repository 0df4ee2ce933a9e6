from .buddy import BuddyStore  # noqa: F401
from .checkpointer import Checkpointer  # noqa: F401
