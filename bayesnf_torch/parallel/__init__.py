"""Device meshes: the ('ens', 'data') grid and the row layout over it."""
