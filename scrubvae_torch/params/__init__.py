from scrubvae_torch.params.param_keys import PARAM_KEYS  # noqa: F401
from scrubvae_torch.params import read  # noqa: F401
