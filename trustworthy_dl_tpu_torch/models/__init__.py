"""GPT-2 (dense and Mixture-of-Experts), ResNet and VGG, the weight
converter and the cached/paged generation paths."""
