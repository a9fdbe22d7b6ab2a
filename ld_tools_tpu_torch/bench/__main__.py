"""``python -m ld_tools_tpu_torch.bench``: the headline benchmark."""

from ld_tools_tpu_torch.bench import headline

if __name__ == "__main__":
    headline.main()
