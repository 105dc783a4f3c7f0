"""The LM scaffold of the port: configs' model families as PyTorch
modules (``common``: config, norms, RoPE, attention; ``blocks``:
attention and MLP blocks; ``transformer``: the layer groups, forward,
prefill and decode)."""
