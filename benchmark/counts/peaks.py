"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit): the yardstick of
every roofline and ``mfu`` share. A card set below 700 W runs slower
under load; the harness prints the card's limit beside every run."""

HBM_BYTES_PER_S = 3.35e12
FLOP_PER_S = {
    "float32": 67e12,       # outside the tensor cores (TF32 is off)
    "tf32": 495e12,
    "bfloat16": 989e12,
    "float16": 989e12,
    "fp8": 1979e12,
}
