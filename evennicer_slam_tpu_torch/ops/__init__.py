"""Device-side primitives: grid sampling, image resize, Gaussian blur, and
the fused NICE decode with its CUDA kernel (counterpart of
``evennicer_slam_tpu/ops``)."""
