from tokenize_audio_tpu_torch.hub.base import ArtifactStore  # noqa: F401
from tokenize_audio_tpu_torch.hub.local import LocalHub  # noqa: F401


def open_hub(spec: str) -> "ArtifactStore":
    """Open an artifact store from a spec string.

    ``"dir:/path"`` (or a bare path) -> LocalHub; ``"hf:org/repo"`` -> HFHub.
    """
    if spec.startswith("hf:"):
        from tokenize_audio_tpu_torch.hub.hf import HFHub

        return HFHub(spec[3:])
    if spec.startswith("dir:"):
        spec = spec[4:]
    return LocalHub(spec)
