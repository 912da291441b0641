"""Prediction: backend resolution, the chunked forward and quantiles."""
