"""The sampling apps (`sample.py`) and their command-line launchers (`cli.py`)."""
