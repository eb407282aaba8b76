"""CPU reference-semantics baselines (accuracy yardsticks, not engine code)."""
