"""Device ops: augment, colour math and the hand-written CUDA kernels."""
