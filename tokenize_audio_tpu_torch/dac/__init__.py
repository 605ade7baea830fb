from tokenize_audio_tpu_torch.dac.config import DacConfig  # noqa: F401
from tokenize_audio_tpu_torch.dac.model import encode  # noqa: F401
from tokenize_audio_tpu_torch.dac.weights import (  # noqa: F401
    convert_hf_state_dict,
    params_from_safetensors,
)
