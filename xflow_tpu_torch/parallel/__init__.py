"""The device step: this slice ports its predict half (PredictStep)."""
