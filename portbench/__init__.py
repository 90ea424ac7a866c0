"""The port's benchmark: long-prompt serving through
``repro_torch.serving.ServingEngine.serve`` on one H100 (see ``run.py``)."""
