"""Task runtimes: datasets, the data loader and the trainers."""
