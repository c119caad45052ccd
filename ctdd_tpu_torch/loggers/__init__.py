"""Figure loggers of the port (noise -> denoise grids, sample grids)."""

from ctdd_tpu_torch.loggers.loggers import (  # noqa: F401
    ConditionalDenoisingNoteSeq,
    denoisingImages,
    get_logger,
    sample_grid_figure,
)
