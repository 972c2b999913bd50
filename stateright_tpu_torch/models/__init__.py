"""Models with the packed tensor form the GPU engine checks (counterpart of
``stateright_tpu/models``)."""
