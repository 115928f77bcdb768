"""The pipeline application API: ``ml_pipeline_*`` parity.

The port of the JAX package's ``api/pipeline_api.py``.  The reference C API
constructs a pipeline from a launch string, then indexes the named
app-facing elements inside it: sinks, app sources, valves and selector
switches (``ml_pipeline_construct`` walking the bin,
``nnstreamer-capi-pipeline.c:426,465-503``).  :class:`PipelineHandle` is
that object model:

- :meth:`construct` / :meth:`start` / :meth:`stop` / :meth:`destroy`
  (``ml_pipeline_construct/start/stop/destroy``)
- :meth:`sink_register`: a frame callback on a named sink
  (``ml_pipeline_sink_register``)
- :meth:`src_input`: push tensors or arrays into a named appsrc
  (``ml_pipeline_src_input_data``); host data reaches the card through a
  ``tensor_upload`` in the string, as every source's does
- :meth:`switch_select`: flip an input or output selector
  (``ml_pipeline_switch_select``)
- :meth:`valve_set_open`: open or close a valve (``ml_pipeline_valve_set_open``)
- :meth:`get_state`, :meth:`wait`
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Union

from ..buffer import Frame
from ..elements.app import AppSink, AppSrc
from ..elements.selector import InputSelector, OutputSelector
from ..elements.sink import TensorSink
from ..elements.valve import Valve
from ..graph.parse import parse_launch
from ..graph.pipeline import Pipeline


class PipelineHandle:
    def __init__(self, description_or_pipeline: Union[str, Pipeline]):
        if isinstance(description_or_pipeline, str):
            self.pipeline = parse_launch(description_or_pipeline)
        else:
            self.pipeline = description_or_pipeline
        # the app-facing elements by name (the bin walk)
        self.sinks: Dict[str, Union[TensorSink, AppSink]] = {}
        self.sources: Dict[str, AppSrc] = {}
        self.valves: Dict[str, Valve] = {}
        self.switches: Dict[str, Union[InputSelector, OutputSelector]] = {}
        for name, node in self.pipeline.nodes.items():
            if isinstance(node, (TensorSink, AppSink)):
                self.sinks[name] = node
            elif isinstance(node, AppSrc):
                self.sources[name] = node
            elif isinstance(node, Valve):
                self.valves[name] = node
            elif isinstance(node, (InputSelector, OutputSelector)):
                self.switches[name] = node

    @classmethod
    def construct(cls, description: str) -> "PipelineHandle":
        return cls(description)

    # -- state (ml_pipeline_start/stop/get_state) ---------------------------

    def start(self) -> "PipelineHandle":
        self.pipeline.start()
        return self

    def stop(self) -> None:
        self.pipeline.stop()

    def get_state(self) -> str:
        return self.pipeline.state

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.pipeline.wait(timeout)

    def destroy(self) -> None:
        if self.pipeline.state == "PLAYING":
            self.pipeline.stop()

    def __enter__(self) -> "PipelineHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.destroy()

    # -- lookups ------------------------------------------------------------

    @staticmethod
    def _find(table: Dict, name: str, kind: str):
        node = table.get(name)
        if node is None:
            raise KeyError(f"no {kind} element named {name!r}")
        return node

    # -- sinks (ml_pipeline_sink_register) ----------------------------------

    def sink_register(self, name: str, callback: Callable[[Frame], None]) -> None:
        self._find(self.sinks, name, "sink").connect("new-data", callback)

    # -- sources (ml_pipeline_src_input_data) -------------------------------

    def src_input(self, name: str, *tensors, pts: int = -1) -> None:
        """Push one frame of torch tensors or numpy arrays (anything else
        goes through ``np.asarray``) into the appsrc ``name``."""
        src = self._find(self.sources, name, "appsrc")
        src.push_frame(Frame(tensors=tensors, pts=pts))

    def src_eos(self, name: str) -> None:
        self._find(self.sources, name, "appsrc").end_of_stream()

    # -- switches / valves (ml_pipeline_switch_select / valve_set_open) -----

    def switch_select(self, name: str, pad: str) -> None:
        self._find(self.switches, name, "selector").select(pad)

    def switch_pads(self, name: str) -> List[str]:
        return self._find(self.switches, name, "selector").pads()

    def valve_set_open(self, name: str, open_: bool) -> None:
        self._find(self.valves, name, "valve").set_open(open_)
