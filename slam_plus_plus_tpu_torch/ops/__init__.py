"""Small-block algebra and the hand-written CUDA kernels with their plain
torch versions."""
