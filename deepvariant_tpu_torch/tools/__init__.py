"""deepvariant_tpu_torch.tools"""
