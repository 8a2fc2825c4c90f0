"""The port's tools: the JAX package's user-facing ones (``convert_torch_ckpt``,
``adapt_clip``, ``export_infer`` with its model-free serving driver
``serve_exported``, and the convergence evidence's ``gen_scenes_r4`` and
``publish_round_eval``), the JAX repo's measurement programs (``bench``,
``bench_serving``, ``bench_quant``, ``bench_train``, ``bench_train_scaling``)
and measurement scripts for the card (``profile_clip``, ``profile_train``,
``kernel_ablation``, ``int8_layers``, ``grad_precision``)."""
