"""The benchmark of ``tnco_tpu_torch``, the PyTorch and CUDA port: cells
of the replica runners on the Sycamore-53 network, read by a data-driven
harness (``python3 -m portbench.run``; see ``portbench/run.py``)."""
