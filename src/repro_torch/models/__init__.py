"""Model substrate (port of ``repro.models``): configs, layers, MoE, SSM,
transformer and encoder-decoder families, on tensors."""
