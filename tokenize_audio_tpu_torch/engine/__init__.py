from tokenize_audio_tpu_torch.engine.encoder import MimiEncoderEngine  # noqa: F401
from tokenize_audio_tpu_torch.engine.metrics import EngineStats  # noqa: F401
