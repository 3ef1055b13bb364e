"""Pipelines: the asset stages and the command line over them."""
