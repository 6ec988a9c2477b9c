"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit). A card set below 700 W reads lower against
them; the benchmark prints the card's power limit beside its numbers."""

#: TF32 tensor-core operations a second: the peak for float32-class products
TF32_FLOPS = 495e12
#: HBM3 bytes a second
HBM_BYTES = 3.35e12
