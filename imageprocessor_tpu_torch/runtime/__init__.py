"""Host runtime: JPEG scan/emit bindings, output paths and the engine."""
