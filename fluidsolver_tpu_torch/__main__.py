from fluidsolver_tpu_torch.driver import main

if __name__ == "__main__":
    main()
