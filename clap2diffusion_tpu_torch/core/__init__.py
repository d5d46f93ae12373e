from clap2diffusion_tpu_torch.core.config import Config, load_config  # noqa: F401
from clap2diffusion_tpu_torch.core.device import resolve_device  # noqa: F401
