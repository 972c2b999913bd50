"""Device operations of the port (counterpart of ``stateright_tpu/ops``):
the word representation, fingerprints, the sorted visited set, and the two
hand-written CUDA kernels with their plain PyTorch versions."""
