from repro_torch.ckpt.checkpoint import array_digest, load_npz, save_npz
