"""Model definitions: dense Llama-class decoder and the model registry."""
