"""GPT-2, ResNet and VGG, the weight converter and the cached/paged
generation paths."""
