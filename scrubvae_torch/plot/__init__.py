from scrubvae_torch.plot import eval as eval_plots  # noqa: F401
from scrubvae_torch.plot import pose_viz  # noqa: F401
from scrubvae_torch.plot.constants import PALETTE_2, PALETTE_DICT, PLANE  # noqa: F401
from scrubvae_torch.plot.plot import (  # noqa: F401
    feature_ridge,
    sample_clusters,
    scatter_cmap,
    trace,
)
