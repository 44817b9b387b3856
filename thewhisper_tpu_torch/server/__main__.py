"""``python -m thewhisper_tpu_torch.server``: the REST streaming server
(``server/launch.py`` documents its environment)."""

from thewhisper_tpu_torch.server.launch import main

if __name__ == "__main__":
    main()
