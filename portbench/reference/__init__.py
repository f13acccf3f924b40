"""The plain reference of the benchmark's check: a frozen copy of the
port's plain PyTorch modules (float32; no kernel, no CUDA library), with
their imports pointed here. It imports nothing of the port, so a later
change to the port's code leaves the yardstick as it is. The fused decode
module is not copied: where the port runs its kernels, the reference runs
plain ops at their precision (``models/decoders.py::nice_forward_packed``)."""
