"""The small model: candidate summary features, the MLP gate that
make_examples runs on the host, and its training loop on the card."""
