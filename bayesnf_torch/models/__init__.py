"""Feature encoders, the neural field and the observation models."""
