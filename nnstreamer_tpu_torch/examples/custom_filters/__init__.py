"""Custom filters for ``tensor_filter framework=custom-python``, in torch.

Each file defines ``class CustomFilter`` (the ``custom-python`` protocol of
``backends/custom.py``), as the JAX package's ``examples/custom_filters``
do:

- ``passthrough.py``: identity, shape-polymorphic;
- ``scaler.py``: nearest-neighbour video resize to ``custom="WxH"``;
- ``average.py``: spatial mean per channel, (H, W, C) → (1, 1, C);
- ``lstm.py``: one parameter-free LSTM-like step, (h, c, x) → (h', c');
- ``rnn.py``: one tanh RNN step, (h, x) → h'.

From a launch string::

    ... ! tensor_filter framework=custom-python
          model=nnstreamer_tpu_torch/examples/custom_filters/scaler.py custom=224x224 ! ...
"""
