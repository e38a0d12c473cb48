"""Physics models of the port."""

from .softbody import SoftbodyModel

__all__ = ["SoftbodyModel"]
