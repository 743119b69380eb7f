"""The TSE recipe's local helpers (`binarize`: PVAD output binarization)."""
