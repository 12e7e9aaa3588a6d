"""Host-side data preparation (numpy): the LLaVA conversation preprocessing."""
