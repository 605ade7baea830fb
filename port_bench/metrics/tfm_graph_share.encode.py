"""tfm_graph_share.encode: the window's device batches whose transformer
stack the program replayed from a CUDA graph (``EngineStats.
transformer_graph_replays``) over the device batches it launched in the
window (``EngineStats.batches``).

The engine captures the stack once per batch shape, at the shape's first
batch, and replays it from the second (``mimi/graphs.py``); the set-up's
warm call launches every shape the window will, so 1.0 means every batch
of the window replayed and none ran the stack's ops one launch at a time.
None where the program counts no batches or keeps no such counter, and
off CUDA, where the program captures no graphs."""


def read(run):
    s = run.stats
    if s is None or run.device.type != "cuda" or not getattr(s, "batches", 0):
        return None
    replays = getattr(s, "transformer_graph_replays", None)
    return None if replays is None else replays / s.batches
