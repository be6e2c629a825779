from .image import (  # noqa: F401
    apply_lut, builtin_lut, decode_png, encode_png, load_lut_png, png_size, save_png,
    to_uint8, save_bscan_png, save_enface_png,
)
from .render import RenderMode, RenderParams, render_volume, compute_sample_depths  # noqa: F401
from .plots import (  # noqa: F401
    LineStats, cast_raw_line, export_csv, plot_curves, plot_lines, select_line,
)
