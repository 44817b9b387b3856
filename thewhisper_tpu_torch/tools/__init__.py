"""Probes of the port: the counterparts of thewhisper_tpu's ``tools/*_probe.py``,
each run as ``python -m thewhisper_tpu_torch.tools.<name>`` on the card, or
with ``--device cpu`` for the numerics alone at a small size."""
