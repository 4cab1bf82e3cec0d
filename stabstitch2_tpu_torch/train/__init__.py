"""Losses of the trainers; so far the grid and path terms the metric scores
use."""
