"""Counterparts of the reference's ``examples/*.py``, run as
``python -m repro_torch.examples.<name>`` (``quickstart``, ``serve_guided``,
``train_lm``, ``window_sweep``): the reference's flags plus ``--device``
(default: the GPU)."""
