"""encode_rtf: audio seconds whose codes ``encode_batch`` returned in the
window, over the window's wall seconds (host clock, every call counted)."""


def read(run):
    return sum(u["audio_s"] for u in run.units) / run.window_s if run.units else None
