"""Pipelines: the asset stages, the command line over them, and the ``demo`` subcommand's world."""
