"""The application API: :class:`SingleShot` (``ml_single_*``) and
:class:`PipelineHandle` (``ml_pipeline_*``)."""

from .pipeline_api import PipelineHandle  # noqa: F401
from .single import InvokeTimeout, SingleShot  # noqa: F401
