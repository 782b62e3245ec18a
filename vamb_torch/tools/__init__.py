"""The workflow tools around `bin`, run as `python -m vamb_torch.tools.<name>`.

Copies of the repo's `src/` scripts that need nothing of JAX:
`concatenate` (the multi-sample contig catalogue), `create_fasta` (bin
FASTAs from a cluster TSV) and `create_kernel` (regenerate the TNF
projection asset). Each takes its script's arguments and has `main(argv)`.
`src/merge_aemb.py` imports only numpy and runs as it is.
"""
