from tokenize_audio_tpu_torch.io.wav import read_wav, write_wav  # noqa: F401
from tokenize_audio_tpu_torch.io.decode import decode_audio, register_decoder  # noqa: F401
