"""The reference's examples on the port: ``python -m
repro_torch.examples.<name>`` (``crossmatch_skyquery``, ``quickstart``,
``serve_multitenant``, ``train_lm``); each takes ``--device`` (``cuda`` by
default)."""
