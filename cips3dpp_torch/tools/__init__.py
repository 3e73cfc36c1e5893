"""Measurement tools of the port (run as `python -m cips3dpp_torch.tools.<name>`)."""
