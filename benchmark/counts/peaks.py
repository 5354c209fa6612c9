"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): operations per second by precision, HBM bytes per
second."""

FLOPS = {
    "bfloat16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,  # outside the tensor cores: TF32 off
}
HBM_BYTES = 3.35e12
