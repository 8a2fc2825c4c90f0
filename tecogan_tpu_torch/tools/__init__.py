"""The port's tools: the JAX package's user-facing ones (``convert_torch_ckpt``,
``adapt_clip``, ``export_infer`` with its model-free serving driver
``serve_exported``) and measurement scripts for the card (``profile_clip``,
``profile_train``, ``kernel_ablation``, ``int8_layers``, ``grad_precision``)."""
