"""device_idle.encode: the share of the window in which no kernel, copy or
memset ran on the card, in percent (``pbkit/trace.window_idle``: the
traced segment's device busy seconds per unit, scaled to the window's
units)."""

from pbkit import trace


def read(run):
    return trace.window_idle(run)
