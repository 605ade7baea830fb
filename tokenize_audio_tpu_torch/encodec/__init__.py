from tokenize_audio_tpu_torch.encodec.config import EncodecConfig  # noqa: F401
from tokenize_audio_tpu_torch.encodec.model import encode  # noqa: F401
from tokenize_audio_tpu_torch.encodec.weights import (  # noqa: F401
    convert_hf_state_dict,
    params_from_safetensors,
)
