from tokenize_audio_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    replicate_params,
)
