"""GPT-2, its weight converter and the cached/paged generation paths."""
