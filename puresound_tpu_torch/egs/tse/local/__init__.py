"""The TSE recipe's local helpers: `binarize` (PVAD output binarization)
and the data preparation (`parser.py`, `make_librispeech_metadata.py`,
`create_vad_label.py`, `create_metadata.sh`), which import this package's
`src` only."""
