"""Operation plans and the planar resample step."""
