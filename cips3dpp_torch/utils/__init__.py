"""Mesh extraction and the software rasterizer of the sampling apps."""
