"""Bundled extensions: capability-equivalents of the reference's external
plugin ecosystem (docs/docs/plugins.md:13-33, .gitmodules:1-24 -- Image
Statistics, Signal Monitor, Peak Detector, Axial PSF Analyzer, Dispersion
Estimator, Phase Extraction, Socket Stream, Camera).  Each subscribes to the
raw or processed stream through the Extension hook API
(octproz_tpu_torch.plugins).  The same names as the JAX package's
``extensions/__init__.py`` exports.
"""

from .statistics import ImageStatisticsExtension, SignalMonitorExtension  # noqa: F401
from .peaks import AxialPsfAnalyzerExtension, PeakDetectorExtension  # noqa: F401
from .calibration import (  # noqa: F401
    DispersionEstimator, estimate_dispersion_coeffs, extract_klin_curve,
)
from .socketstream import SocketStreamServer  # noqa: F401
from .camera import (  # noqa: F401
    CallableCamera, CameraExtension, DirectoryCamera,
)
