"""Stream elements.  Modules are imported lazily through the registry
(:mod:`nnstreamer_tpu_torch.graph.registry`)."""
