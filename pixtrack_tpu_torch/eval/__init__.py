"""Evaluation: pose-tracking metrics."""
