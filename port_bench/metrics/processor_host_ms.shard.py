"""processor_host_ms.shard: the YODAS2 processor's host stages in the
window (fetch, extract, decode, slice, serialize, assemble, upload; thread
seconds, which overlap one another and the encode), in milliseconds per
published audio second. The resample stage nests inside decode and is not
counted twice."""

STAGES = ("source_fetch", "host_extract", "host_decode", "host_slice",
          "host_serialize", "host_assemble", "hub_upload")


def read(run):
    audio = sum(u["audio_s"] for u in run.units)
    if run.stats is None or not audio:
        return None
    return 1000.0 * sum(run.stats.stage_seconds.get(s, 0.0) for s in STAGES) / audio
