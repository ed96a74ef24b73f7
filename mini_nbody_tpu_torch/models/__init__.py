"""Port of mini_nbody_tpu/models."""
