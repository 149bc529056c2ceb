"""Operation and byte counts computed from shapes, and the card's published
peaks.  One module a kernel or a model (``counts/<name>.py``), so the count
stays the same whatever implements the work."""
