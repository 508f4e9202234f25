"""Dense decoder of the port: layers, SwiGLU MLP, attention and the model."""
