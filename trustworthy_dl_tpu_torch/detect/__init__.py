"""Rolling baselines for the serve-side output monitor."""
