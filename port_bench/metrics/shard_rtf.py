"""shard_rtf: audio seconds of the chunks ``Yodas2ShardProcessor.process``
published to the hub in the window, over the window's wall seconds (host
clock, every pass counted)."""


def read(run):
    return sum(u["audio_s"] for u in run.units) / run.window_s if run.units else None
