"""The port's tools: the kernel tools (`attn_experiments`,
`mha_phase_bench`, with what they share in `common`) and the real-weights
path (`fabricate`, `validate_weights`, `make_null_text_encoding`)."""
