"""bucket_efficiency.encode: valid frames over padded frames the engine
encoded in the window (``EngineStats.frames / padded_frames``)."""


def read(run):
    s = run.stats
    return s.frames / s.padded_frames if s is not None and s.padded_frames else None
