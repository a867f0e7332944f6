"""Small-block algebra, the hand-written CUDA kernels with their plain
torch versions, and the fixed-order segmented sums."""
