"""The reference's seven example scripts as modules of the port.

Each runs as ``python -m repro_torch.examples.<name>`` with the reference
script's flags, targets, layers and printed markers: ``quickstart``,
``compile_layers``, ``new_accelerator``, ``sweep_variants`` and
``warm_start_search`` drive the Covenant compiler (numpy host code, no
card); ``serve_lm`` and ``train_lm`` run a model through the Hopper
kernels on ``--device cuda`` unless asked for ``--device cpu``.
"""
