"""Seconds from `render` to the PNG of a final render on one GPU: the
window's time up to the end of the last finished render, over the finished
renders (host clock)."""
from readers import seconds_per_render as read  # noqa: F401
